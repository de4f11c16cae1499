// Fused bias-aware attention, forward: out = softmax(q k^T + bias + (mask - 1) * 1e9) v.
//
// Replaces: vidchapters_tpu/ops/fused_attention.py::_fused_forward / _fwd_kernel
// (the pl.pallas_call at line 163), forward only and without dropout.
// Scores are unscaled, as in T5.
//
// What bounds it on the H100: at the T5-base encoder's shape (B=8, H=12,
// L=1024, D=64, bf16) one call does 4*B*H*L^2*D = 25.8 GFLOP and must move
// q, k, v, out (50 MB) plus the [1,H,L,L] bias (25 MB). On the tensor cores
// that is ~26 us of FLOPs against ~22 us of bytes, so a tensor-core kernel
// would be bound by both about equally.
//
// Design: one block of 256 threads per (b, h, 64-row query tile). The block
// streams 64-key K/V tiles through shared memory (converted to fp32) and
// keeps an online softmax per query row: running max, running sum, and an
// fp32 accumulator in registers (each thread owns 4 rows x D/16 columns).
// Nothing of size L x L is written to device memory, and the bias is read
// once. The TPU kernel instead held all of K/V in VMEM and ran a plain
// softmax; that layout does not fit a block's shared memory and is not
// copied. This first version multiplies on the fp32 CUDA cores, not with
// wgmma, so it is bound by fp32 operations (67 TFLOP/s peak) far above the
// tensor-core bound above; moving the two products onto wgmma is the next
// step.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per streamed tile
constexpr int NT = 256;  // threads: 16 x 16, thread (ty, tx) owns rows ty + 16 i, keys tx + 16 j

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fused_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bias, const int* __restrict__ key_mask, T* __restrict__ out,
    int H, int Lq, int Lk) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK + 1]
  constexpr int CD = D / 16;         // output columns per thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * H + h;
  const T* qp = q + bh * Lq * D;
  const T* kp = k + bh * Lk * D;
  const T* vp = v + bh * Lk * D;
  const T* bp = bias ? bias + (long)h * Lq * Lk : nullptr;
  const int* mp = key_mask + (long)b * Lk;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = (q0 + r < Lq) ? vc::to_f(qp[(long)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const long g = (long)(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = vc::to_f(kp[g]);
      Vs[r * D + d] = vc::to_f(vp[g]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float madd = ((float)mp[key] - 1.f) * 1e9f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (bp != nullptr && row < Lq) s[i][j] += vc::to_f(bp[(long)row * Lk + key]);
        s[i][j] += madd;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float sc = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * sc + ps;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= sc;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* op = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c)
      op[(long)row * D + tx + 16 * c] = vc::from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* key_mask, void* out, int B, int H, int Lq, int Lk,
           cudaStream_t stream) {
  auto kern = fused_attention_fwd_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const int*>(key_mask), static_cast<T*>(out),
      H, Lq, Lk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* bias,
               const void* key_mask, void* out, int B, int H, int Lq, int Lk, int D,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, bias, key_mask, out, B, H, Lq, Lk, stream);
    case 64: return launch<T, 64>(q, k, v, bias, key_mask, out, B, H, Lq, Lk, stream);
    case 128: return launch<T, 128>(q, k, v, bias, key_mask, out, B, H, Lq, Lk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Lq,D], k/v [B,H,Lk,D], bias [1,H,Lq,Lk] or null, key_mask [B,Lk] int32,
// out [B,H,Lq,D]; all contiguous, Lk a multiple of 64, D in {32, 64, 128}.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* key_mask, void* out,
                                   int B, int H, int Lq, int Lk, int D, int dtype,
                                   void* stream) {
  if (Lk % BK != 0 || Lq <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32)
    return dispatch_d<float>(q, k, v, bias, key_mask, out, B, H, Lq, Lk, D, s);
  if (dtype == VC_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, bias, key_mask, out, B, H, Lq, Lk, D, s);
  return (int)cudaErrorInvalidValue;
}
