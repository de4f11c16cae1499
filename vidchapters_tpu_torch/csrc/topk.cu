// Small-k top-k over rows: values and indices of the k largest entries of each
// row, largest first, ties to the smallest index (lax.top_k's order).
//
// Replaces: vidchapters_tpu/ops/decoding.py::_topk_pallas (the pl.pallas_call
// at line 269), reached through _topk_small once per beam-search step.
//
// What bounds it on the H100: at the serving shape [8, 4 * 32200] f32 the
// call must read 4.1 MB once (~1.2 us at 3.35 TB/s) and does almost no
// arithmetic, so a single call is bound by launch latency, not by the card.
//
// Design: one block per row, so the row is read from device memory once.
// Each thread walks a strided slice and keeps a sorted top-k in registers
// (insertion by compare-and-swap, fully unrolled; ties keep the earlier
// index because each thread meets its indices in increasing order). The
// block then merges the per-thread lists in shared memory with k rounds of
// a block-wide arg-best over the list heads, comparing (value, -index), so
// equal values resolve to the smallest index exactly as lax.top_k does.

#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXK = 16;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(NT) topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
                                                  int* __restrict__ idxs, int N, int K) {
  __shared__ float sv[NT * MAXK];
  __shared__ int si[NT * MAXK];
  __shared__ float wv[NT / 32];
  __shared__ int wi[NT / 32];
  __shared__ int winner;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* row = x + (long)blockIdx.x * N;

  float lv[MAXK];
  int li[MAXK];
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    lv[j] = -CUDART_INF_F;
    li[j] = INT_MAX;
  }
  for (int i = tid; i < N; i += NT) {
    float cv = vc::to_f(row[i]);
    int ci = i;
#pragma unroll
    for (int j = 0; j < MAXK; ++j) {
      if (j < K && better(cv, ci, lv[j], li[j])) {
        const float tv = lv[j];
        const int ti = li[j];
        lv[j] = cv;
        li[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAXK; ++j) {
    if (j < K) {
      sv[tid * K + j] = lv[j];
      si[tid * K + j] = li[j];
    }
  }
  __syncthreads();

  int head = 0;
  for (int r = 0; r < K; ++r) {
    float v = head < K ? sv[tid * K + head] : -CUDART_INF_F;
    int i = head < K ? si[tid * K + head] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = i;
    }
    __syncthreads();
    if (tid == 0) {
      float bv = wv[0];
      int bi = wi[0];
      for (int w = 1; w < NT / 32; ++w)
        if (better(wv[w], wi[w], bv, bi)) {
          bv = wv[w];
          bi = wi[w];
        }
      vals[(long)blockIdx.x * K + r] = vc::from_f<T>(bv);
      idxs[(long)blockIdx.x * K + r] = bi;
      winner = bi;
    }
    __syncthreads();
    if (head < K && si[tid * K + head] == winner) ++head;
    __syncthreads();  // wv / wi / winner are rewritten next round
  }
}

}  // namespace

// x [B, N] contiguous, vals [B, K] of x's dtype, idxs [B, K] int32; 1 <= K <= 16 <= N.
extern "C" int topk(const void* x, void* vals, void* idxs, int B, int N, int K, int dtype,
                    void* stream) {
  if (K < 1 || K > MAXK || N < K || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_DTYPE_F32)
    topk_kernel<float><<<B, NT, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(vals),
                                        static_cast<int*>(idxs), N, K);
  else if (dtype == VC_DTYPE_BF16)
    topk_kernel<__nv_bfloat16><<<B, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(vals),
        static_cast<int*>(idxs), N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
