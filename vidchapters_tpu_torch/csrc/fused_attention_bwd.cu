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
// What bounds it on the H100: at the T5-base encoder's shape (B=8, H=12,
// L=1024, D=64, bf16) the backward does five L x L x D products per (b, h),
// 10*B*H*L^2*D = 64 GFLOP, and moves q, k, v, out, dout, the bias (88 MB in
// bf16) plus dq, dk, dv and dbias in fp32 (126 MB): ~65 us of tensor-core
// FLOPs against ~64 us of bytes. This first version multiplies on the fp32
// CUDA cores (67 TFLOP/s), so it is far above that bound, as the forward is.
//
// Design: the TPU grid is (h, b) with b running in order, and it carries
// dbias across b in VMEM. Hopper runs blocks in no order, so the work is
// split into three launches, none with float atomics, so that two runs give
// the same bits:
//   1. delta: one warp per query row.
//   2. dk/dv: one block of 256 threads per (64-key tile, h), which walks b in
//      order and, for each b, every 64-row query tile. It keeps dk and dv of
//      its key tile in registers and writes them once per b; it adds each b's
//      dS into the dbias column [h, :, key tile], which no other block
//      touches, so the sum over b runs in the TPU kernel's order. Without a
//      bias there is nothing to carry across b, and the grid also splits b.
//   3. dq: one block per (64-row query tile, h, b), walking the key tiles.
// Both recompute the 64 x 64 score tile from q and k in shared memory
// (converted to fp32); each thread owns 4 x 4 of it, as in the forward.

#include "common.cuh"

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
  void *dq, *dk, *dv, *dbias, *delta;
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

}  // namespace

// q [B,H,Lq,D], k/v [B,H,Lk,D], bias [1,H,Lq,Lk] or null, key_mask [B,Lk] int32,
// out/dout [B,H,Lq,D] (the forward's output and its gradient, q's dtype),
// lse [B,H,Lq] float32 from the forward; writes dq/dk/dv (float32, the shapes
// of q/k/v), dbias [1,H,Lq,Lk] float32 when bias is given, and uses delta
// [B,H,Lq] float32 as scratch. All contiguous, Lk a multiple of 64, D in
// {32, 64, 128}. Dropout arguments as in fused_attention_fwd.
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* key_mask, const void* out,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* dbias, void* delta, int B, int H, int Lq,
                                   int Lk, int D, int dtype, unsigned seed, int use_dropout,
                                   int thresh, float inv, void* stream) {
  if (Lk % BK != 0 || Lq <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, key_mask, out, dout, lse, dq, dk, dv, dbias, delta,
               B, H, Lq, Lk, vc::Dropout{seed, use_dropout, (unsigned)thresh, inv}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32) return dispatch_d<float>(a, D, s);
  if (dtype == VC_DTYPE_BF16) return dispatch_d<__nv_bfloat16>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
